from .qps import QPSData, read_qps, solve_qps_data, to_problem, write_qps
