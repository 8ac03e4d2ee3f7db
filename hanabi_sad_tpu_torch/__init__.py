"""PyTorch / CUDA port of `hanabi_sad_tpu` for one NVIDIA H100.

The port imports torch and numpy only; it never imports jax or the JAX
package. Its entry points run on `cuda` unless the caller passes
`device="cpu"`; without a card and without an explicit device they raise.
"""
