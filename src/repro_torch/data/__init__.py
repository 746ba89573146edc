"""The LM zoo's token data pipeline (numpy batches)."""
