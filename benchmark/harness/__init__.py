"""The harness: names, records, device and trace readers, the yardstick."""
