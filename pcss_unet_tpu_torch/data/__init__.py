"""Data-side helpers the port needs so far (the train-set channel stats)."""
