"""Data preparation: the eight-stage pipeline that turns raw talking-head
videos into training-ready 256² face clips."""
