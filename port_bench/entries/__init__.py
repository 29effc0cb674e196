"""The calls a window can drive, one module per traffic `entry`, found
by name (port_bench/entries/<entry>.py, class `Entry`)."""
