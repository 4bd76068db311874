"""The host schedulers' disk spill (spill.py); the multi-GPU modules of the
JAX package's parallel/ are not ported."""
