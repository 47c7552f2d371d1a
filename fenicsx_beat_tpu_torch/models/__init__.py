"""Ionic models of the port."""
