"""Host utilities of the port (its own copies of the JAX package's): bit-granular
stream stitching, phase timing, size formatting, the progress bar and the
ring queue of the code-table build."""
