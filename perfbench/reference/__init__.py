"""The benchmark's plain reference (torch and numpy only; nothing of the
program, of the JAX package or of JAX)."""
