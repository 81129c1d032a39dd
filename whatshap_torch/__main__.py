"""
whatshap-torch: read-based phasing of genomic variants on a CUDA GPU

Subcommand launcher (counterpart of whatshap/__main__.py).  Subcommand
modules live in ``whatshap_torch/cli``; their module
docstrings double as help text and are read via ``ast`` so that listing
commands does not pay the import cost of every pipeline.  Each module provides
``add_arguments(parser)``, optionally ``validate(args, parser)``, and
``main(args)``.
"""

import ast
import importlib
import importlib.util
import logging
import pkgutil
import sys
from typing import Iterator, List, Optional, Tuple

from . import __version__
from . import cli as cli_package
from .args import HelpfulArgumentParser
from .cli import CommandLineError

logger = logging.getLogger(__name__)


class NiceFormatter(logging.Formatter):
    """Log INFO lines bare; prefix every other level with its name."""

    def format(self, record):
        if record.levelno != logging.INFO:
            record.msg = f"{record.levelname}: {record.msg}"
        return super().format(record)


def setup_logging(debug: bool) -> None:
    handler = logging.StreamHandler()
    handler.setFormatter(NiceFormatter())
    root = logging.getLogger()
    root.addHandler(handler)
    root.setLevel(logging.DEBUG if debug else logging.INFO)


def _available_commands() -> Iterator[Tuple[str, str]]:
    """(name, docstring) of every documented module under the cli package,
    parsed statically — nothing is imported."""
    for info in pkgutil.iter_modules(cli_package.__path__):
        spec = importlib.util.find_spec(f"{cli_package.__name__}.{info.name}")
        with open(spec.origin) as src:
            tree = ast.parse(src.read())
        doc = ast.get_docstring(tree, clean=False)
        if doc is not None:
            yield info.name, doc


def _first_doc_line(doc: str) -> str:
    return doc.strip().split("\n", maxsplit=1)[0]


def _resolve_subcommand(argv: List[str]) -> str:
    """Light pre-parse: register every command name (help text only, no
    arguments) and let argparse pick out which one argv names."""
    parser = HelpfulArgumentParser(description=__doc__, prog="whatshap")
    parser.add_argument("--version", action="version", version=__version__)
    commands = parser.add_subparsers()
    for name, doc in _available_commands():
        sub = commands.add_parser(
            name,
            help=_first_doc_line(doc).replace("%", "%%"),
            description=doc,
            add_help=False,
        )
        sub.set_defaults(chosen_command=name)
    known, _ = parser.parse_known_args(argv)
    chosen = getattr(known, "chosen_command", None)
    if chosen is None:
        parser.error("Please provide the name of a subcommand to run")
    return chosen


# kept under its historical name for external callers
def get_subcommand_name(arguments: List[str]) -> str:
    return _resolve_subcommand(arguments)


def main(argv: Optional[List[str]] = None) -> None:
    if argv is None:
        argv = sys.argv[1:]
    command = _resolve_subcommand(argv)
    module = importlib.import_module(f".{command}", cli_package.__name__)

    parser = HelpfulArgumentParser(description=__doc__, prog="whatshap")
    parser.add_argument("--version", action="version", version="%(prog)s " + __version__)
    parser.add_argument("--debug", action="store_true", default=False, help="Print debug messages")
    commands = parser.add_subparsers()
    subparser = commands.add_parser(
        command, help=_first_doc_line(module.__doc__), description=module.__doc__
    )
    module.add_arguments(subparser)

    args = parser.parse_args(argv)
    setup_logging(args.debug)
    if hasattr(module, "validate"):
        module.validate(args, subparser)
    del args.debug

    try:
        module.main(args)
    except CommandLineError as e:
        logger.error("whatshap error: %s", e)
        logger.debug("Command line error. Traceback:", exc_info=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
