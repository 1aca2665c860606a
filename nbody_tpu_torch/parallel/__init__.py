"""Multi-device execution of nbody_tpu_torch (the particle ring)."""
