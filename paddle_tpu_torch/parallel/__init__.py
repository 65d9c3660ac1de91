"""Sharding annotations of program variables and the logical-axis rule
table (``axis_rules``); no mesh in the port yet."""
