"""Input pipeline of the port: the token loader."""
