"""The benchmark's plain reference: what the program's outputs must decrypt
to, worked out in plain PyTorch and Python integers from the configuration
and the benchmark's own inputs. It imports nothing of the program."""
