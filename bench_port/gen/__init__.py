"""Inputs of the benchmark, made from a seed: the reference genome of a
configuration (genome.py) and the reads of a run (reads.py).  Plain
numpy; nothing here imports the program."""
