"""The benchmark's harness: cells, drivers, the trace reader and the yardstick."""
