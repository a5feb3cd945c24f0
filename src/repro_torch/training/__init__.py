"""Training stack of the port: ``ctc`` (CTC loss, greedy decoding, PER),
``optimizer`` (AdamW + schedules), ``checkpoint`` (atomic, async,
retained checkpoints; also what the serving snapshots ride) and
``trainer`` (the paper's two-phase CBTD pretrain / DeltaLSTM retrain)."""
