"""ZapRAID as the trainer's checkpoint store (``zapraid_ckpt``) and erasure
coding of live optimizer state across data-parallel ranks
(``state_parity``), both on the codec's kernels."""
