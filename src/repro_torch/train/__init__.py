"""The LM zoo's training substrate: AdamW, int8 gradient compression,
checkpoints and the fault-tolerant trainer, on torch tensors."""
