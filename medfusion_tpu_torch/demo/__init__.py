"""The browser demo and the micro-batched serving endpoint (``server``,
``serving``)."""
