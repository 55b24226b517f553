"""Model configuration, layers and the decoder assembly of the port."""
