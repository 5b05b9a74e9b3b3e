"""The plain reference of the benchmark's correctness check: decodes the
same text the program decodes, in NumPy and Python alone. It imports
nothing of the program under test (`etlbench/tests` checks this)."""
