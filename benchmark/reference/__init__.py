"""The plain reference that decides `correct`: a frozen copy of the scalar
oracle of gencore's consensus pipeline (position and UMI clustering, the
quality-weighted vote with reference arbitration, duplex merging, the
FR/RR tags) with the host modules it needs, in pure Python and NumPy.

It imports nothing of the program under test, and the program cannot edit
it: it lives under the benchmark's own paths. It reads the same BAM, FASTA
and BED files the program is given and works everything out from them.
"""
