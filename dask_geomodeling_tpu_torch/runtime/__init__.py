"""The torch executor, the batched tile runtime and the packed fetch."""
