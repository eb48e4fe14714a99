"""The plain reference that decides a run's ``correct``.

Python integers mod p, hashlib and nothing else: it imports neither JAX
nor the program under test, and takes none of the program's tables.  It
re-derives every public quantity (the field's roots, the MiMC chain's
output, the transition zerofier at the opened points, the Fiat-Shamir
challenges) and judges the proofs that the
timed path produced: their Merkle openings, FRI layers and colinearity,
the last codeword's degree, and the combination of the openings at every
query point.  The protocol is "Anatomy of a STARK" (aszepieniec/
stark-anatomy, code/fast_stark.py, fri.py)
with the commitment and transcript encodings that the port states in
its DEVIATIONS (blake2s over 16-byte little-endian elements, paired
leaves, the tag-length-value transcript).
"""
