"""The benchmark's plain reference: the Goursat scheme and its exact adjoint
(:mod:`.goursat`) and the timed calls built on it (:mod:`.calls`).  It
imports nothing of the program, of the JAX package or of JAX."""
