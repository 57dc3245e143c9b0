"""The benchmark's plain reference: the program's plain torch and numpy
paths, frozen as copies (each file names the file it was copied from), and
``run.py``, the runner's scan engine over a sample of points.  It imports
nothing of the program, of the JAX package or of JAX."""
