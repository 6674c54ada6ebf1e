"""One module per kind of traffic (``driver`` in a traffic file): each has
``run(ctx) -> Run``."""
