"""The benchmark's general code: finding a cell's files by name, the inputs
drawn from the seed, the traced window's reduction and the run's guards."""
