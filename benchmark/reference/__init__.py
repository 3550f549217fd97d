"""Plain references of the benchmark's cells: PyTorch and NumPy only.

Nothing here imports the program under test (`sepi_tpu_torch`), the JAX
package it was ported from, or anything the program made: the harness
hands the reference the same raw inputs and weights it hands the program.
"""
