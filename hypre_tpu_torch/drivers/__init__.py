"""Command-line drivers of the port (hypre's test drivers)."""
