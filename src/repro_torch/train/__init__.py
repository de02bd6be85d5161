"""Training on the card: AdamW, NUMARCK gradient compression, the trainer."""
