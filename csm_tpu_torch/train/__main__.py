"""``python -m csm_tpu_torch.train [arguments]``: the training CLI
(:func:`csm_tpu_torch.train.cli.main`)."""

from csm_tpu_torch.train.cli import main

if __name__ == "__main__":
    main()
