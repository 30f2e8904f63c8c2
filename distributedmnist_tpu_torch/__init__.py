"""PyTorch/CUDA port of distributedmnist_tpu.

A package of its own beside the JAX one, which stays the reference. It
imports torch and numpy, never jax and nothing of distributedmnist_tpu.
The port's kernels are hand-written CUDA for Hopper (csrc/, bound in
ops/). Its serving stack (serve/) serves the MLP end to end:
`python -m distributedmnist_tpu_torch.serve --model mlp --selftest N`.
Its trainer (trainer.py) trains the two single-card workloads:
`python -m distributedmnist_tpu_torch.train --preset mlp-sgd|lenet-adam`.
"""
