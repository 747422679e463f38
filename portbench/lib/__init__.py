"""The benchmark's yardstick: traffic, statistics, trace reduction, work
counts and peaks.  Nothing here imports the port."""
