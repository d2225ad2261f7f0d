"""Bridges to the reference PyTorch implementation (uzh-rpg/bflow):
``reference_oracle`` runs its network as a numerical oracle. Reading a
reference Lightning ``.ckpt`` needs no converter here: the port's
modules carry the reference's ``net.*`` names
(``train/checkpoint.py:port_state_dict``)."""
