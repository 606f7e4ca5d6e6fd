"""DAVIS interactive evaluation: metrics, robot, protocol loop."""
