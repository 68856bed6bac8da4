"""Job kinds: one general generator each, found by the ``kind`` of a cell's traffic."""
