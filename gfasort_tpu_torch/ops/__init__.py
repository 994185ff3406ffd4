"""Device side of the port: the 1D and nD sweep engines, their sampler,
key schedule, plans and consensus, the bucket-apply kernel wrappers, and
the host copies they use (the exact oracle, the eta schedule, the
fastpow tables, the sweep policy)."""
