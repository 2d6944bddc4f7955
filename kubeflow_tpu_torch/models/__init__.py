"""The model family and the serving engines of the port."""
