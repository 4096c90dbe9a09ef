"""Core numerics: kernels, linear algebra, scalers/PCA, fused GP predict."""
