"""Subcommands of `python -m trivy_tpu_torch` beyond `fs`."""
