"""The yardstick: traffic, the window, the trace reduction, the roofline."""
