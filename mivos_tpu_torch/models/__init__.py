"""Networks: propagation and fusion."""
