"""
Polyploid phasing (counterpart of whatshap/polyphase/ and of
whatshap_tpu.polyphase).  Only the switch/flip distance that compare uses is
here so far (switchflip.py, re-exported by solver.py); the polyphase
pipeline's shared types and block splitting come with its own modules.
"""
