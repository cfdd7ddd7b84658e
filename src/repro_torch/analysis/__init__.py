"""Analysis tools of the port (the paper's gradient-space PCA)."""
