"""hymet_tpu_torch — the PyTorch/CUDA port of hymet_tpu.

The port runs on one NVIDIA H100. Plain tensor work is PyTorch; the one
hand-written Pallas kernel of the JAX package (the screen's k-mer hash)
is a hand-written CUDA kernel here (:mod:`hymet_tpu_torch.ops.hash_kernels`),
as are the XLA programs torch has no primitive for (the aligner's,
:mod:`hymet_tpu_torch.ops.align_kernels`, and the weighted LCA,
:mod:`hymet_tpu_torch.ops.lca`). The whole run is
:class:`hymet_tpu_torch.pipeline.run.ClassificationRun`.
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

# Rank labels the lineage parsers accept (same as hymet_tpu.RANK_ALIAS).
# The reference table (classification_cami.py:17-26) lacks the identity
# "superkingdom" key, so `superkingdom:X` entries are silently dropped by its
# parser; the identity mapping is a deliberate, documented deviation.
RANK_ALIAS = {
    "superkingdom": "superkingdom",
    "domain": "superkingdom",
    "kingdom": "superkingdom",
    "sk": "superkingdom",
    "k": "superkingdom",
    "phylum": "phylum",
    "p": "phylum",
    "class": "class",
    "c": "class",
    "order": "order",
    "o": "order",
    "family": "family",
    "f": "family",
    "genus": "genus",
    "g": "genus",
    "species": "species",
    "s": "species",
    "subspecies": "strain",
    "ss": "strain",
    "strain": "strain",
}
