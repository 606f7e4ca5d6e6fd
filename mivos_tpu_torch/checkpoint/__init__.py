"""Weight loading: the JAX package's parameter trees and reference .pth files."""
