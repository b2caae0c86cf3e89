"""Golden-file regression harness of the port."""
