"""PyTorch / CUDA port of loner_tpu for NVIDIA Hopper.

Modules mirror ``loner_tpu``'s paths. The package imports torch and numpy,
never jax, optax or yaml, and nothing of ``loner_tpu``.
"""
