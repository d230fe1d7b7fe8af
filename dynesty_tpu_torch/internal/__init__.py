"""Device-side machinery: likelihood wrapper, proposal kernels, fused
rounds and their host drivers."""
