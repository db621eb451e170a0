"""The benchmark's yardstick: the manifest, traffic, timing, the trace's
reduction, operation and byte counts and the published peaks."""
