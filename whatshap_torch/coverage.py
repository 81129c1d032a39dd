"""Per-position coverage tracker used by read selection
(parity with whatshap/coverage.py)."""


class CovMonitor:
    def __init__(self, length):
        self.coverage = [0] * length

    def max_coverage_in_range(self, begin, end):
        return max(self.coverage[begin:end])

    def add_read(self, begin, end):
        for i in range(begin, end):
            self.coverage[i] += 1
