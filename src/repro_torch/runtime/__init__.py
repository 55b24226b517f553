"""Runtime: the elastic executor that re-plans on device loss."""
