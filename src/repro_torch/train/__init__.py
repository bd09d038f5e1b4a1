"""LM training: AdamW, the train step, checkpoints and the trainer loop."""
