"""`python -m sepi_tpu_torch ...`: the command line (`cli.main`)."""

from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
