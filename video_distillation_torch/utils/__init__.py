"""Device selection, logging and checkpoints."""
