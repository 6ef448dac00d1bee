"""Host-side graph store (numpy CSR)."""
