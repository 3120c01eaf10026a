"""Traffic drivers, one per ``kind`` of a traffic mix."""
