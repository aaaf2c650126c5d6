"""The benchmark's own arithmetic of operations and bytes."""
