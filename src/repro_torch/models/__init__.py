"""Model code of the port: layers, attention helpers, the paged transformer."""
