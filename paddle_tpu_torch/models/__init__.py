"""Models: the decoder-only transformer LM's serving path."""
