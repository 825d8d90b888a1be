"""The benchmark's general machinery: finding a cell's files by name,
statistics, the device trace and its guard, the table of peaks, and the
check that nothing of JAX is loaded."""
