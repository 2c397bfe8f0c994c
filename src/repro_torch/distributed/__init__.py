"""Distributed training helpers; on one card, gradient compression."""
