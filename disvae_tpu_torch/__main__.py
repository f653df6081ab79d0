"""`python -m disvae_tpu_torch <args>` == the evaluation CLI (cli.py)."""

from disvae_tpu_torch.cli import cli

if __name__ == "__main__":
    cli()
