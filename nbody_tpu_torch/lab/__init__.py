"""Kernel labs: candidate variants of the port's kernels, measured against
production on the card (``python -m nbody_tpu_torch.lab.kernel_lab``)."""
