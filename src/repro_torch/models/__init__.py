"""Dense LM of the port: training loss, prefill and decode."""
