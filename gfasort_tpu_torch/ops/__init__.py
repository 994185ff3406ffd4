"""Device side of the port: the 1D and nD sweep engines, their sampler,
key schedule, plans and consensus, the bucket-apply kernel wrappers, the
fused sweep apply and the shift-sum probe kernels, and the host copies
they use (the exact oracle, the eta schedule, the fastpow tables, the
sweep policy)."""
