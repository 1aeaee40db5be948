"""The sequential scheduling engine: encoder, plugin bodies, the engine and
the bindings of its CUDA kernels."""
