"""A frozen copy of the plain twins of `cnc_torch` (the PyTorch port of CNC):
the benchmark's reference.

Each module here is a copy of one module of the port, kept to its plain
path: every branch that dispatched a CUDA tensor to a hand-written kernel is
gone, so on any device these functions run plain torch operations (the
port's CPU tests hold these twins against `cnc_tpu`).  They are frozen with
the benchmark: a later change to the port does not reach them, so the
benchmark keeps judging the port against the semantics it had when the
benchmark was made.  Nothing here imports `cnc_torch`, `cnc_tpu` or JAX.
"""
