"""`python -m covomix_tpu_torch.train`: the port's training CLI (train/cli.py)."""

from covomix_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
