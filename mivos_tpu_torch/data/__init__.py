"""Data loading: DAVIS test sequences and host-side transforms."""
