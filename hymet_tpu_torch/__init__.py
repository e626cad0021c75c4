"""hymet_tpu_torch — the PyTorch/CUDA port of hymet_tpu.

The port runs on one NVIDIA H100. Plain tensor work is PyTorch; the one
hand-written Pallas kernel of the JAX package (the screen's k-mer hash)
is a hand-written CUDA kernel here (:mod:`hymet_tpu_torch.ops.hash_kernels`).
This package imports neither ``jax`` nor anything of ``hymet_tpu``: where
it needs one of that package's helpers, it keeps its own copy. Entry
points take ``device=`` and default to ``"cuda"``; they raise when no
card is visible, and run on the CPU only when asked to.
"""

__version__ = "0.1.0"

# Canonical rank order (same as hymet_tpu.RANKS; reference
# scripts/classification_cami.py:16).
RANKS = [
    "superkingdom",
    "phylum",
    "class",
    "order",
    "family",
    "genus",
    "species",
    "strain",
]

# CAMI profiles use the 7-rank form (no strain); reference tools/hymet2cami.py:14.
CAMI_RANKS = RANKS[:-1]
