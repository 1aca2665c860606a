"""``python -m nbody_tpu_torch``: the precision-ladder comparison CLI."""

from nbody_tpu_torch.cli import main

if __name__ == "__main__":
    main()
