"""Device engine: batched JAX kernels for the hot loops (SURVEY.md §3
ranking): affine-gap alignment, repeat scans, k-mer graph construction,
cleanup and path cover. All are plain JAX that XLA compiles for the
backend in use (the GPU in production, the CPU in tests). Each kernel is
validated bit-exact against the oracle engine in lancet_jax.engine.

The persistent XLA compilation cache is NOT enabled at import: import-
time config would force a backend choice. The runner and the device
graph driver enable it lazily through
lancet_jax.engine.devicepipe._enable_compile_cache, in
JAX_COMPILATION_CACHE_DIR when that is set and otherwise in the fixed,
git-ignored `.jax_cache/` of the checkout (GPU backends; see
devicepipe.compile_cache_dir for why CPU runs go without).
"""
