"""The benchmark's yardstick: peaks, byte counts and trace reduction."""
