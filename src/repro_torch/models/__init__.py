"""Dense LM of the serving slice."""
