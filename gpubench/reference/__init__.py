"""The plain references the benchmark judges the program by. They import
neither ``jax``, the JAX package nor the program: plain PyTorch, float32
with TF32 off, from the benchmark's own weights and inputs.

``reference/<family>.py`` defines ``prefill_logits(a, seed, prompts,
device, precision="f32")`` (each prompt's last-position logits) and
``train(a, seed, batches, opt, device, precision="f32",
chunk_tokens=4096)`` (the first AdamW steps: each step's loss, each
leaf's first gradient norm and its change, under the benchmark's weight
names). ``precision="fp8"`` is the control that a lower precision has to
fail."""
