"""What every cell shares: the inputs, the weights, the work counts, the
card's peaks, the reading of the trace and the manifest."""
