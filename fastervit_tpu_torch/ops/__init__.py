"""Window ops and the attention dispatch with its CUDA kernel."""
