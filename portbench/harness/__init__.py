"""The benchmark's own machinery: cells and files found by name, the
yardstick (peaks, byte and operation counts), inputs made from the seed,
the traced window's records, and the result line."""
