"""The benchmark's harness: cells read from data (spec), the seeded
weights and the wrappers on the timed path (capture), the reference's
judgement (check), the traced slice (trace), the yardstick's arithmetic
(counts), the readers' shared arithmetic (readers) and the no-JAX guard
(guard); cell.run_cell runs one cell once."""
