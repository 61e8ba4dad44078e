"""Plain PyTorch and NumPy references of what the benchmark's cells run.

Nothing here imports the program under test (``repro_torch``), the JAX
package or JAX: each module works out again, from the inputs the harness
makes, what the program derives from them (the mixing matrix, the
calibrated constants, the partition, the noise bits, the sensitivity
scalar, the model's losses and gradients).
"""
