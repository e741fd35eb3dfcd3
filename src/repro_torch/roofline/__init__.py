"""The three-term roofline: the analytic model (`analysis`) and the
port's counter of one step's FLOPs and bytes on the meta device
(`count`)."""
