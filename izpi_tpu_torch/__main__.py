"""`python -m izpi_tpu_torch`: the command-line renderer (`cli.main`)."""

from izpi_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())
