"""Data layer (numpy copies of ``repro.data``): synthetic temporal
fields and the LM token pipeline."""
