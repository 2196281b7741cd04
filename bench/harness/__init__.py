"""What every cell shares: the manifest and its files, the seeded inputs
(weights and batches), and the comparison that decides ``correct``."""
