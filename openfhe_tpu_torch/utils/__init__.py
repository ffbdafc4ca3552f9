"""Host-side helpers of the port: exact Python ints and numpy (number
theory, sampling, security tables, the PRNG, Field2n, Matrix), the archive
format and the timing utilities."""
