"""The torch executor, the batched tile runtime and the numpy host
executor."""
