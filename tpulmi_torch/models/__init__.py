"""The MLP router and its training."""
