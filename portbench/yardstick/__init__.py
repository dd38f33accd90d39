"""The yardstick later changes to the program cannot move: the cost model,
the table of peaks, the work behind what a run delivered, the roofline
arithmetic."""
