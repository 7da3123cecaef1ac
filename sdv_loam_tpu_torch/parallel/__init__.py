"""Many sequences over several devices (counterpart of
`sdv_loam_tpu/parallel/`): `mesh` lays a batch of sequences out over the
visible cards, `dryrun` drives the production programs and fleets there."""
