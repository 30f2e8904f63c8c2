"""The benchmark's yardstick: set-up of the process, the manifest and
its files, seeded inputs, window arithmetic, work counts, the device
trace, and the comparisons that decide `correct`."""
