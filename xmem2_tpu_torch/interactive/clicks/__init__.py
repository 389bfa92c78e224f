"""Click encoding for f-BRS: distance maps and the Clicker."""
