"""Plain PyTorch and NumPy references the runs are held against.  Nothing
here imports the program under test or JAX."""
