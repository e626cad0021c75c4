"""Data tooling (the port of hymet_tpu.data, host code): dataset
subsetting, seqid maps, synthetic test datasets, derived CAMI samples —
the reference's L6 layer (SURVEY.md §1, §2.5)."""
