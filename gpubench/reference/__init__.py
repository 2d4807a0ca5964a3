"""The plain references the benchmark judges the program by. They import
neither ``jax``, the JAX package nor the program: plain PyTorch, float32
with TF32 off, from the benchmark's own weights and inputs."""
